"""PodGC: reaps terminated, orphaned, and unscheduled-terminating pods.

The counterpart of `kubernetes_tpu/controllers/podgc.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller/podgc/gc_controller.go — three sweeps:
gcTerminated (terminated pods beyond --terminated-pod-gc-threshold, oldest
first), gcOrphaned (pods bound to nodes that no longer exist), and
gcUnscheduledTerminating (deleting pods that never got a node). Time-driven
like the reference's 20s resync.
"""

from __future__ import annotations

from ..store import NotFoundError
from .base import Controller

DEFAULT_TERMINATED_THRESHOLD = 12500


class PodGCController(Controller):
    watch_kinds = ("pods", "nodes")
    SWEEP_INTERVAL = 20.0

    def __init__(self, store, clock=None,
                 terminated_threshold: int = DEFAULT_TERMINATED_THRESHOLD):
        super().__init__(store, clock)
        self.terminated_threshold = terminated_threshold
        self._last_sweep = float("-inf")

    def key_of_object(self, kind, obj):
        # purely time-driven (the reference's 20s gcCheckPeriod): reacting to
        # every pod/node event would run a full-store sweep per phase write.
        # No keys -> base sync() is never invoked; sweep() is the only path.
        return None

    def reconcile_once(self) -> int:
        n = super().reconcile_once()
        if self.clock.now() - self._last_sweep >= self.SWEEP_INTERVAL:
            self._last_sweep = self.clock.now()
            n += self.sweep()
        return n

    def sweep(self) -> int:
        deleted = 0
        pods, _ = self.store.list("pods")
        node_names = {n.metadata.name
                      for n in self.store.list("nodes")[0]}

        # orphaned: bound to a node that is gone (gcOrphaned) — the kubelet
        # that would run them no longer exists, so nothing else reaps them
        for p in pods:
            if p.spec.node_name and p.spec.node_name not in node_names:
                deleted += self._delete(p)

        # unscheduled terminating: deletionTimestamp set, never placed
        for p in pods:
            if (p.metadata.deletion_timestamp is not None
                    and not p.spec.node_name):
                deleted += self._delete(p)

        # terminated beyond threshold, oldest first (gcTerminated)
        terminated = sorted(
            (p for p in pods if p.is_terminal()),
            key=lambda p: p.metadata.creation_timestamp)
        excess = len(terminated) - self.terminated_threshold
        for p in terminated[:max(excess, 0)]:
            deleted += self._delete(p)
        return deleted

    def _delete(self, pod) -> int:
        try:
            self.store.delete("pods", self.store.object_key(pod))
            return 1
        except NotFoundError:
            return 0
