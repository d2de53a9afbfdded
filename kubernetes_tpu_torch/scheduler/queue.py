"""3-tier scheduling queue: activeQ + backoffQ + unschedulablePods.

The counterpart of `kubernetes_tpu/scheduler/queue.py` (reference:
pkg/scheduler/backend/queue/scheduling_queue.go — PriorityQueue :154,
AddUnschedulableIfNotPresent :741, flushBackoffQCompleted :790, Pop :829,
MoveAllToActiveOrBackoffQueue :1028; backoff_queue.go:64, initial 1s, max
10s). Pop order is the default QueueSort: priority descending, then
admission time, then admission sequence; a profile's custom QueueSort
plugin replaces it through its less(). A cluster event moves the
unschedulable pods that its QueueingHints select (move_pods_for_event, fed by
scheduler/serial.py _move_for_event from each pod's unschedulable_plugins).
The flush cadence is the schedulers' background loops: Scheduler.start()
(scheduler/serial.py) flushes the backoff and unschedulable tiers whenever a
pop times out (50 ms), BatchScheduler.start() (scheduler/batch.py) on every
idle cycle; run_until_idle callers flush them themselves.

Observability sinks, installed by BatchScheduler: stat_sink (the flight
recorder) times each bulk admission into its "queue_add" bucket, and
trace_sink (the pod tracer) is handed every admission batch's
QueuedPodInfos for reservoir sampling, after the queue lock is released.
telemetry() and depths() are the gauges' and the time series' reads.

Gang gating (scheduler/gang.py): with gang hooks installed, members of a
PodGroup are held in a STAGING area, a fourth tier beside active, backoff
and unschedulable, until the group reaches quorum (staged + already placed
>= min_member); then the whole gang is admitted contiguously (one
timestamp, consecutive sequence numbers) so a single solver batch sees it
together. A failed gang re-enters through add_gang_backoff as a unit (one
shared expiry); a gang whose victim cover fired waits in the PARKED tier
until the preemptor releases it (scheduler/gangpreempt.py).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..api import Pod
from ..server import metrics
from ..utils import Clock

DEFAULT_POD_INITIAL_BACKOFF = 1.0  # seconds (scheduler.go:252)
DEFAULT_POD_MAX_BACKOFF = 10.0  # seconds (scheduler.go:253)
FLUSH_UNSCHEDULABLE_TIMEOUT = 30.0  # scheduling_queue.go:91


class _LessItem:
    """Adapts a QueueSort plugin's less(a, b) into a heap sort key."""

    __slots__ = ("qp", "less")

    def __init__(self, qp, less):
        self.qp = qp
        self.less = less

    def __lt__(self, other):
        return self.less(self.qp, other.qp)

    def __eq__(self, other):
        return not self.less(self.qp, other.qp) and not self.less(other.qp, self.qp)


@dataclass
class QueuedPodInfo:
    """reference: framework types.go:362 QueuedPodInfo."""

    pod: Pod
    timestamp: float = 0.0
    attempts: int = 0
    # the plugins that rejected the pod's last attempt: the QueueingHints
    # that may move it back read them (scheduler/serial.py _move_for_event)
    unschedulable_plugins: Tuple[str, ...] = ()
    # first-admission time, NEVER reset by requeues (timestamp is): the
    # submit->bound latency the pod tracer observes spans every retry. Set
    # from the admission batch's shared clock read, no per-pod clock calls.
    submit_ts: float = 0.0
    # the pod's live PodSpan when it is in the tracer's sample, linked at
    # sampling time (scheduler/podtrace.py): the bind path's per-chunk pass
    # pays ONE attribute read per pod. None for the unsampled ~100%.
    trace_span: object = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if not self.submit_ts:
            self.submit_ts = self.timestamp

    @property
    def key(self) -> str:
        return self.pod.key


class SchedulingQueue:
    def __init__(self, clock: Optional[Clock] = None,
                 initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
                 max_backoff: float = DEFAULT_POD_MAX_BACKOFF,
                 pre_enqueue: Optional[Callable[[Pod], bool]] = None, less=None):
        self._clock = clock or Clock()
        self._initial_backoff = initial_backoff
        self._max_backoff = max_backoff
        # (QueuedPodInfo, QueuedPodInfo) -> bool of a custom QueueSort plugin;
        # None is the default priority order
        self._less = less
        # pre_enqueue(pod) -> bool, re-checked on every promotion into activeQ
        self._pre_enqueue = pre_enqueue
        self._lock = threading.Condition()
        self._seq = itertools.count()
        self._active: List[Tuple] = []  # heap of (sort key, seq, qp)
        self._in_active: Dict[str, QueuedPodInfo] = {}
        self._backoff: List[Tuple[float, int, QueuedPodInfo]] = []
        # pod key -> [its QueuedPodInfo, entries in the backoff heap]: a pod
        # MODIFIED while it waits out its backoff is found without a scan
        self._backoff_of: Dict[str, list] = {}
        self._unschedulable: Dict[str, QueuedPodInfo] = {}
        # gang staging: group key -> {pod key: qp}. Hooks are installed by the
        # batch scheduler (set_gang_hooks); without them, or while
        # gang_active() is False, every gang path is skipped.
        self._gang_of = None  # (pod) -> Optional[str]
        self._gang_ready = None  # (group, staged_count) -> Optional[bool]
        self._gang_active = None  # () -> bool
        self._gang_staging: Dict[str, Dict[str, QueuedPodInfo]] = {}
        # parked gangs (victim cover fired): off every retry loop until the
        # preemptor releases them; still pending for the conservation check
        self._gang_parked: Dict[str, Dict[str, QueuedPodInfo]] = {}
        # stage-timing sink (a FlightRecorder, installed by BatchScheduler):
        # bulk-admission wall time accrues to its "queue_add" bucket so the
        # batch pipeline's stage table can attribute ingest sub-stages
        self.stat_sink = None
        # lifecycle-trace sink (a PodTracer, installed by BatchScheduler):
        # notified once per admission batch, AFTER the queue lock releases,
        # with the freshly admitted QueuedPodInfos for reservoir sampling
        self.trace_sink = None

    def set_gang_hooks(self, gang_of, gang_ready, gang_active) -> None:
        """Install gang gating: gang_of(pod) names the pod's group (None for
        non-members), gang_ready(group, staged) decides quorum, gang_active()
        is the batch-level fast-out (False until any PodGroup exists)."""
        with self._lock:
            self._gang_of = gang_of
            self._gang_ready = gang_ready
            self._gang_active = gang_active

    def _gang_gate(self):
        """gang_of while gang gating is on, else None."""
        if self._gang_active is not None and self._gang_active():
            return self._gang_of
        return None

    def _sort_key(self, qp: QueuedPodInfo):
        # default QueueSort (priority_sort.go): priority desc, timestamp asc;
        # a custom QueueSort plugin's less() overrides via _LessItem
        if self._less is not None:
            return _LessItem(qp, self._less)
        return (-qp.pod.spec.priority, qp.timestamp)

    # -- add paths -------------------------------------------------------------

    def add(self, pod: Pod) -> None:
        with self._lock:
            qp = QueuedPodInfo(pod=pod, timestamp=self._clock.now())
            self._push_active(qp)
            self._lock.notify()
        ts = self.trace_sink
        if ts is not None:
            ts.admitted((qp,))

    def add_batch(self, pods: List[Pod]) -> None:
        """Admission of one coalesced watch delivery: one lock, one clock
        read, the same pop order as len(pods) calls of add(). The caller has
        run PreEnqueue on every pod. With an enabled stat_sink the admission
        is timed into its "queue_add" bucket (and the stage histogram); the
        trace_sink samples the admitted pods after the lock is released."""
        if not pods:
            return
        sink = self.stat_sink
        if sink is not None and sink.enabled:
            admitted = []
            t0 = time.perf_counter()
            try:
                admitted = self._add_batch_locked(pods)
            finally:
                t1 = time.perf_counter()
                sink.add_outside("queue_add", t1 - t0)
                metrics.batch_stage_duration.observe(t1 - t0, "queue_add")
                sink.note_self_time(time.perf_counter() - t1)
        else:
            admitted = self._add_batch_locked(pods)
        ts = self.trace_sink
        if ts is not None and admitted:
            ts.admitted(admitted)

    def _add_batch_locked(self, pods: List[Pod]) -> List[QueuedPodInfo]:
        """add_batch's body under the lock; returns the QueuedPodInfos that
        entered the active tier, in admission order (released gang members
        included)."""
        admitted: List[QueuedPodInfo] = []
        with self._lock:
            now = self._clock.now()
            gang_of = self._gang_gate()
            for pod in pods:
                qp = QueuedPodInfo(pod=pod, timestamp=now)
                self._unschedulable.pop(qp.key, None)
                if qp.key in self._in_active:
                    continue
                group = gang_of(pod) if gang_of is not None else None
                if group is not None:
                    for m in self._gang_stage(group, qp):
                        self._heap_push(m)
                        admitted.append(m)
                    continue
                self._heap_push(qp)
                admitted.append(qp)
            self._lock.notify_all()
        return admitted

    def _push_active(self, qp: QueuedPodInfo) -> None:
        self._unschedulable.pop(qp.key, None)
        if qp.key in self._in_active:
            return
        if self._pre_enqueue is not None and not self._pre_enqueue(qp.pod):
            self._unschedulable[qp.key] = qp  # still gated: stay parked
            return
        gang_of = self._gang_gate()
        if gang_of is not None:
            group = gang_of(qp.pod)
            if group is not None:
                for m in self._gang_stage(group, qp):
                    self._heap_push(m)
                return
        self._heap_push(qp)

    def _heap_push(self, qp: QueuedPodInfo) -> None:
        self._in_active[qp.key] = qp
        heapq.heappush(self._active, (self._sort_key(qp), next(self._seq), qp))

    # -- gang staging (scheduler/gang.py) --------------------------------------

    def _gang_stage(self, group: str, qp: QueuedPodInfo) -> List[QueuedPodInfo]:
        """Stage one gang member; returns the members to admit NOW ([] while
        the group is below quorum). Admitted members share one timestamp, so
        with equal priorities they pop contiguously."""
        self._gang_staging.setdefault(group, {})[qp.key] = qp
        return self._gang_collect(group, requester=qp)

    def _gang_collect(self, group: str,
                      requester: Optional[QueuedPodInfo] = None) -> List[QueuedPodInfo]:
        staged = self._gang_staging.get(group)
        if (not staged or self._gang_ready is None
                or not self._gang_ready(group, len(staged))):
            return []
        if self._pre_enqueue is not None:
            # a gate may have closed on a member staged earlier: it breaks
            # quorum and the gang keeps waiting
            for key, m in list(staged.items()):
                if m is requester:
                    continue
                if not self._pre_enqueue(m.pod):
                    staged.pop(key)
                    self._unschedulable[key] = m
            if not staged or not self._gang_ready(group, len(staged)):
                if not staged:
                    self._gang_staging.pop(group, None)
                return []
        self._gang_staging.pop(group, None)
        now = self._clock.now()
        members = list(staged.values())
        for m in members:
            m.timestamp = now
        return members

    def reconsider_gangs(self) -> None:
        """Re-evaluate every staged group's quorum (on PodGroup events and
        membership changes: a created or raised PodGroup, or bound siblings,
        can unblock members that arrived first)."""
        with self._lock:
            moved = False
            for group in list(self._gang_staging):
                for m in self._gang_collect(group):
                    self._heap_push(m)
                    moved = True
            if moved:
                self._lock.notify_all()

    def park_gang(self, group: str, members: List[QueuedPodInfo]) -> None:
        """Park a preempting gang: its victim cover fired and the deletions are
        in flight. The members wait out of every retry loop until
        release_parked_gang moves them back. Re-parking replaces."""
        if not members:
            return
        with self._lock:
            slot = self._gang_parked.setdefault(group, {})
            for m in members:
                slot[m.key] = m

    def release_parked_gang(self, group: str) -> int:
        """Move a parked gang back through the admission path: the members
        re-stage under their group, reach quorum together and admit
        contiguously, without a backoff wait. Returns the members released."""
        with self._lock:
            slot = self._gang_parked.pop(group, None)
            if not slot:
                return 0
            now = self._clock.now()
            for m in slot.values():
                m.timestamp = now
                self._push_active(m)
            self._lock.notify_all()
            return len(slot)

    def add_gang_backoff(self, members: List[QueuedPodInfo]) -> None:
        """Requeue a failed gang as a UNIT: every member enters the backoff
        tier under ONE shared expiry (the slowest member's), so the gang
        re-stages and re-admits together."""
        if not members:
            return
        with self._lock:
            now = self._clock.now()
            ready = now + max(self._backoff_duration(m.attempts) for m in members)
            for m in members:
                m.timestamp = now
                self._backoff_push(ready, m)

    def add_unschedulable(self, qp: QueuedPodInfo) -> None:
        """AddUnschedulableIfNotPresent (:741): failed pods wait for an event."""
        with self._lock:
            qp.timestamp = self._clock.now()
            self._unschedulable[qp.key] = qp

    def add_backoff(self, qps: List[QueuedPodInfo]) -> None:
        """Transient-error requeue (the solver failure domain): straight into
        the backoff tier with a per-pod expiry from its attempt count. Unlike
        add_unschedulable, no cluster event is needed before the retry: the
        pod is fine, the infrastructure hiccuped."""
        if not qps:
            return
        with self._lock:
            now = self._clock.now()
            for qp in qps:
                qp.timestamp = now
                self._backoff_push(now + self._backoff_duration(qp.attempts), qp)

    def _backoff_push(self, ready: float, qp: QueuedPodInfo) -> None:
        heapq.heappush(self._backoff, (ready, next(self._seq), qp))
        entry = self._backoff_of.get(qp.key)
        if entry is None:
            self._backoff_of[qp.key] = [qp, 1]
        else:
            entry[0] = qp
            entry[1] += 1

    def _backoff_popped(self, key: str) -> None:
        entry = self._backoff_of.get(key)
        if entry is not None:
            entry[1] -= 1
            if entry[1] <= 0:
                del self._backoff_of[key]

    def _backoff_duration(self, attempts: int) -> float:
        d = self._initial_backoff * (2 ** max(attempts - 1, 0))
        return min(d, self._max_backoff)

    def _backoff_remaining(self, qp: QueuedPodInfo) -> float:
        if qp.attempts == 0:
            return 0.0
        expiry = qp.timestamp + self._backoff_duration(qp.attempts)
        return max(0.0, expiry - self._clock.now())

    def move_all_to_active_or_backoff(self) -> None:
        """MoveAllToActiveOrBackoffQueue (:1028) on a cluster event."""
        self.move_pods_for_event(lambda qp: True)

    def move_pods_for_event(self, should_move) -> None:
        """movePodsToActiveOrBackoffQueue (:1028) gated by QueueingHints:
        should_move(qp) -> bool decides, per unschedulable pod, whether this
        cluster event could make it schedulable (the scheduler derives it from
        the rejecting plugins' hint functions — scheduling_queue.go:263
        QueueingHintMap + podMatchesEvent). Pods that stay are still swept by
        flush_unschedulable_left_over (the reference's safety net)."""
        with self._lock:
            moved = False
            for key, qp in list(self._unschedulable.items()):
                if not should_move(qp):
                    continue
                self._unschedulable.pop(key)
                remaining = self._backoff_remaining(qp)
                if remaining > 0:
                    self._backoff_push(self._clock.now() + remaining, qp)
                else:
                    self._push_active(qp)
                moved = True
            if moved:
                self._lock.notify_all()

    # -- flush loops (queue.Run :350) ------------------------------------------

    def flush_backoff_completed(self) -> None:
        with self._lock:
            now = self._clock.now()
            while self._backoff and self._backoff[0][0] <= now:
                _, _, qp = heapq.heappop(self._backoff)
                self._backoff_popped(qp.key)
                self._push_active(qp)
            self._lock.notify_all()

    def flush_unschedulable_left_over(self) -> None:
        """Pods unschedulable for longer than 30 s are requeued (:350). Gang
        members staged under a group with NO PodGroup (deleted, or never
        created) are released as ordinary pods after the same window; a
        group with a live PodGroup below quorum keeps waiting."""
        released = 0
        with self._lock:
            now = self._clock.now()
            moved = False
            for key, qp in list(self._unschedulable.items()):
                if now - qp.timestamp > FLUSH_UNSCHEDULABLE_TIMEOUT:
                    self._unschedulable.pop(key)
                    self._push_active(qp)
                    moved = True
            for group in list(self._gang_staging):
                staged = self._gang_staging[group]
                if (self._gang_ready is None
                        or self._gang_ready(group, len(staged)) is not None):
                    continue
                for key, qp in list(staged.items()):
                    if now - qp.timestamp > FLUSH_UNSCHEDULABLE_TIMEOUT:
                        staged.pop(key)
                        self._heap_push(qp)
                        moved = True
                        released += 1
                if not staged:
                    self._gang_staging.pop(group, None)
            if moved:
                self._lock.notify_all()
        if released:
            metrics.gang_orphan_released_total.inc(released)

    # -- pop -------------------------------------------------------------------

    def pop(self, timeout: Optional[float] = None) -> Optional[QueuedPodInfo]:
        """Pop (:829): the next pod in pop order, waiting up to timeout
        seconds for one (None waits until a pod arrives)."""
        with self._lock:
            while not self._active:
                if not self._lock.wait(timeout=timeout):
                    return None
            _, _, qp = heapq.heappop(self._active)
            self._in_active.pop(qp.key, None)
            qp.attempts += 1
            return qp

    def pop_batch(self, max_n: int) -> List[QueuedPodInfo]:
        """Up to max_n pods in pop order (the batching analog of Pop)."""
        out: List[QueuedPodInfo] = []
        with self._lock:
            if len(self._active) <= max_n:
                # draining everything: one sort in the same total order
                drained = sorted(self._active)
                self._active = []
            else:
                drained = [heapq.heappop(self._active) for _ in range(max_n)]
            for _, _, qp in drained:
                self._in_active.pop(qp.key, None)
                qp.attempts += 1
                out.append(qp)
        return out

    # -- removal / updates -----------------------------------------------------

    def update(self, pod: Pod) -> bool:
        """Pod MODIFIED while queued. Only a spec change can affect
        schedulability (eventhandlers.go updatePodInSchedulingQueue): a
        status-only patch such as our own PodScheduled condition must not
        requeue. Returns True if the pod was known to the queue."""
        with self._lock:
            key = pod.key
            staged_in = None
            tracked = self._in_active.get(key) or self._unschedulable.get(key)
            if tracked is None and key in self._backoff_of:
                tracked = self._backoff_of[key][0]
            if tracked is None:
                for group, staged in self._gang_staging.items():
                    if key in staged:
                        tracked, staged_in = staged[key], group
                        break
            if tracked is None:
                # parked for a victim cover: keep the object fresh but stay
                # parked (the preemptor owns when the gang re-enters)
                for parked in self._gang_parked.values():
                    if key in parked:
                        tracked = parked[key]
                        break
            if tracked is None:
                return False
            # status-only writes don't requeue (our own PodScheduled
            # condition would loop), except resourceClaimStatuses: the claim
            # controller's stamp resolves template claim references, which
            # gates schedulability exactly like spec
            spec_changed = (tracked.pod.spec != pod.spec
                            or tracked.pod.status.resource_claim_statuses
                            != pod.status.resource_claim_statuses)
            labels_changed = tracked.pod.metadata.labels != pod.metadata.labels
            tracked.pod = pod
            if (spec_changed or labels_changed) and staged_in is not None:
                # labels carry gang membership: re-stage under the current
                # group (or leave staging if no longer a member)
                staged = self._gang_staging.get(staged_in)
                if staged is not None:
                    staged.pop(key, None)
                    if not staged:
                        self._gang_staging.pop(staged_in, None)
                self._push_active(tracked)
                self._lock.notify()
                return True
            if spec_changed:
                if key in self._unschedulable:
                    self._unschedulable.pop(key)
                    remaining = self._backoff_remaining(tracked)
                    if remaining > 0:
                        self._backoff_push(self._clock.now() + remaining, tracked)
                    else:
                        self._push_active(tracked)
                        self._lock.notify()
                elif key in self._in_active:
                    # the heap key was computed at push time: re-sort
                    self._in_active.pop(key)
                    self._active = [e for e in self._active if e[2].key != key]
                    heapq.heapify(self._active)
                    self._push_active(tracked)
                    self._lock.notify()
            return True

    def delete(self, pod: Pod) -> None:
        self.delete_key(pod.key)

    def delete_key(self, key: str) -> None:
        with self._lock:
            self._unschedulable.pop(key, None)
            for tier in (self._gang_staging, self._gang_parked):
                for group in list(tier):
                    members = tier[group]
                    if members.pop(key, None) is not None and not members:
                        tier.pop(group, None)
            if self._in_active.pop(key, None) is not None:
                self._active = [e for e in self._active if e[2].key != key]
                heapq.heapify(self._active)
            if self._backoff_of.pop(key, None) is not None:
                self._backoff = [e for e in self._backoff if e[2].key != key]
                heapq.heapify(self._backoff)

    def clear(self) -> None:
        """Drop every queued pod across all tiers (resync repopulates from a
        fresh LIST)."""
        with self._lock:
            self._active.clear()
            self._in_active.clear()
            self._backoff.clear()
            self._backoff_of.clear()
            self._unschedulable.clear()
            self._gang_staging.clear()
            self._gang_parked.clear()

    def _gang_tiers(self):
        return itertools.chain(self._gang_staging.values(), self._gang_parked.values())

    def contains(self, key: str) -> bool:
        """O(1) membership probe across every tier (active, backoff,
        unschedulable; gang staging and parking by a scan of their small
        group dicts). The partitioned dispatch layer calls this once a
        FOREIGN bound-pod event to clean a stale local entry after losing a
        cross-partition race, so it must never cost an O(queue) scan."""
        with self._lock:
            if (key in self._in_active or key in self._unschedulable
                    or key in self._backoff_of):
                return True
            return any(key in members for members in self._gang_tiers())

    def add_requeued(self, qps: List[QueuedPodInfo]) -> None:
        """Admit EXISTING QueuedPodInfos straight into the active tier,
        keeping their attempt counts and timestamps: the partitioned
        dispatch layer re-routes a pod that proved infeasible in one node
        shard to the next partition's queue through here. No backoff: the
        pod was offered the wrong shard, and the router's hop count bounds
        the re-routing, so this cannot livelock."""
        if not qps:
            return
        with self._lock:
            for qp in qps:
                self._push_active(qp)
            self._lock.notify_all()

    def tracked_keys(self) -> List[str]:
        """Keys of every pod the queue knows, across all tiers (gang staging
        and parking included)."""
        with self._lock:
            return (list(self._in_active) + [e[2].key for e in self._backoff]
                    + list(self._unschedulable)
                    + [k for members in self._gang_tiers() for k in members])

    def unschedulable_pods(self) -> List[QueuedPodInfo]:
        with self._lock:
            return list(self._unschedulable.values())

    # -- introspection ---------------------------------------------------------

    def lengths(self) -> Tuple[int, int, int]:
        """(active, backoff, unschedulable); staged and parked gang members
        count as unschedulable (waiting, the same observable meaning)."""
        with self._lock:
            waiting = sum(len(m) for m in self._gang_tiers())
            return len(self._active), len(self._backoff), len(self._unschedulable) + waiting

    def gang_staged_count(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._gang_staging.values())

    def gang_parked_count(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._gang_parked.values())

    def depths(self) -> Dict[str, int]:
        """Per-tier depth dict WITHOUT the O(queue) oldest-age scan
        telemetry() pays: the window-close probe (obs/timeseries.py) reads
        this unthrottled, so it stays O(tiers)."""
        with self._lock:
            return {"active": len(self._active),
                    "backoff": len(self._backoff),
                    "unschedulable": len(self._unschedulable),
                    "gang_staged": sum(len(s) for s in self._gang_staging.values()),
                    "gang_parked": sum(len(s) for s in self._gang_parked.values())}

    def telemetry(self) -> Dict[str, float]:
        """Queue depth by tier plus the age of the oldest pod still waiting
        anywhere (first-admission time, so a pod cycling through backoff
        keeps aging). One O(queue) scan a call: the batch scheduler updates
        its gauges per pump, throttled, never per pod."""
        with self._lock:
            now = self._clock.now()
            waiting = itertools.chain(
                (e[2] for e in self._active),
                (e[2] for e in self._backoff),
                self._unschedulable.values(),
                (qp for members in self._gang_tiers() for qp in members.values()))
            oldest = min((qp.submit_ts or qp.timestamp for qp in waiting), default=None)
            return {
                "active": len(self._active),
                "backoff": len(self._backoff),
                "unschedulable": len(self._unschedulable),
                "gang_staged": sum(len(s) for s in self._gang_staging.values()),
                "gang_parked": sum(len(s) for s in self._gang_parked.values()),
                "oldest_pending_age_s": (max(0.0, now - oldest)
                                         if oldest is not None else 0.0),
            }
