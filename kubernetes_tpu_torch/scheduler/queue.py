"""3-tier scheduling queue: activeQ + backoffQ + unschedulablePods.

The counterpart of `kubernetes_tpu/scheduler/queue.py` (reference:
pkg/scheduler/backend/queue/scheduling_queue.go — PriorityQueue :154,
AddUnschedulableIfNotPresent :741, flushBackoffQCompleted :790, Pop :829,
MoveAllToActiveOrBackoffQueue :1028; backoff_queue.go:64, initial 1s, max
10s). Pop order is the default QueueSort: priority descending, then
admission time, then admission sequence. Gang staging and parking come with
gangs (ROADMAP.md queue 1 item 3); custom QueueSort plugins with the serial
framework (item 2); the background flush loops with the daemon (item 7).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..api import Pod
from ..utils import Clock

DEFAULT_POD_INITIAL_BACKOFF = 1.0  # seconds (scheduler.go:252)
DEFAULT_POD_MAX_BACKOFF = 10.0  # seconds (scheduler.go:253)


@dataclass
class QueuedPodInfo:
    """reference: framework types.go:362 QueuedPodInfo."""

    pod: Pod
    timestamp: float = 0.0
    attempts: int = 0
    unschedulable_plugins: Tuple[str, ...] = ()

    @property
    def key(self) -> str:
        return self.pod.key


class SchedulingQueue:
    def __init__(self, clock: Optional[Clock] = None,
                 initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
                 max_backoff: float = DEFAULT_POD_MAX_BACKOFF,
                 pre_enqueue: Optional[Callable[[Pod], bool]] = None):
        self._clock = clock or Clock()
        self._initial_backoff = initial_backoff
        self._max_backoff = max_backoff
        # pre_enqueue(pod) -> bool, re-checked on every promotion into activeQ
        self._pre_enqueue = pre_enqueue
        self._lock = threading.Condition()
        self._seq = itertools.count()
        self._active: List[Tuple] = []  # heap of (sort key, seq, qp)
        self._in_active: Dict[str, QueuedPodInfo] = {}
        self._backoff: List[Tuple[float, int, QueuedPodInfo]] = []
        self._unschedulable: Dict[str, QueuedPodInfo] = {}

    @staticmethod
    def _sort_key(qp: QueuedPodInfo):
        # default QueueSort (priority_sort.go): priority desc, timestamp asc
        return (-qp.pod.spec.priority, qp.timestamp)

    # -- add paths -------------------------------------------------------------

    def add(self, pod: Pod) -> None:
        with self._lock:
            self._push_active(QueuedPodInfo(pod=pod, timestamp=self._clock.now()))
            self._lock.notify()

    def add_batch(self, pods: List[Pod]) -> None:
        """Admission of one coalesced watch delivery: one lock, one clock
        read, the same pop order as len(pods) calls of add(). The caller has
        run PreEnqueue on every pod."""
        if not pods:
            return
        with self._lock:
            now = self._clock.now()
            for pod in pods:
                qp = QueuedPodInfo(pod=pod, timestamp=now)
                self._unschedulable.pop(qp.key, None)
                if qp.key not in self._in_active:
                    self._heap_push(qp)
            self._lock.notify_all()

    def _push_active(self, qp: QueuedPodInfo) -> None:
        self._unschedulable.pop(qp.key, None)
        if qp.key in self._in_active:
            return
        if self._pre_enqueue is not None and not self._pre_enqueue(qp.pod):
            self._unschedulable[qp.key] = qp  # still gated: stay parked
            return
        self._heap_push(qp)

    def _heap_push(self, qp: QueuedPodInfo) -> None:
        self._in_active[qp.key] = qp
        heapq.heappush(self._active, (self._sort_key(qp), next(self._seq), qp))

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
                heapq.heappush(self._backoff, (now + self._backoff_duration(qp.attempts),
                                               next(self._seq), qp))

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
        with self._lock:
            for key, qp in list(self._unschedulable.items()):
                self._unschedulable.pop(key)
                remaining = self._backoff_remaining(qp)
                if remaining > 0:
                    heapq.heappush(self._backoff, (self._clock.now() + remaining,
                                                   next(self._seq), qp))
                else:
                    self._push_active(qp)
            self._lock.notify_all()

    # -- flush loops (queue.Run :350) ------------------------------------------

    def flush_backoff_completed(self) -> None:
        with self._lock:
            now = self._clock.now()
            while self._backoff and self._backoff[0][0] <= now:
                _, _, qp = heapq.heappop(self._backoff)
                self._push_active(qp)
            self._lock.notify_all()

    # -- pop -------------------------------------------------------------------

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
            tracked = self._in_active.get(key) or self._unschedulable.get(key)
            if tracked is None:
                for _, _, qp in self._backoff:
                    if qp.key == key:
                        tracked = qp
                        break
            if tracked is None:
                return False
            spec_changed = tracked.pod.spec != pod.spec
            tracked.pod = pod
            if spec_changed:
                if key in self._unschedulable:
                    self._unschedulable.pop(key)
                    remaining = self._backoff_remaining(tracked)
                    if remaining > 0:
                        heapq.heappush(self._backoff, (self._clock.now() + remaining,
                                                       next(self._seq), tracked))
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
            if self._in_active.pop(key, None) is not None:
                self._active = [e for e in self._active if e[2].key != key]
                heapq.heapify(self._active)
            if any(e[2].key == key for e in self._backoff):
                self._backoff = [e for e in self._backoff if e[2].key != key]
                heapq.heapify(self._backoff)

    def tracked_keys(self) -> List[str]:
        """Keys of every pod the queue knows, across all three tiers."""
        with self._lock:
            return (list(self._in_active) + [e[2].key for e in self._backoff]
                    + list(self._unschedulable))

    def unschedulable_pods(self) -> List[QueuedPodInfo]:
        with self._lock:
            return list(self._unschedulable.values())
