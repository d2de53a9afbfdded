"""Taint-based eviction: pods on NoExecute-tainted nodes are evicted, honoring
tolerations and tolerationSeconds.

The counterpart of `kubernetes_tpu/controllers/tainteviction.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller/tainteviction/taint_eviction.go — per-pod timed
eviction queue: an untolerated NoExecute taint evicts immediately; a toleration
with tolerationSeconds delays eviction by that long; tolerations without
tolerationSeconds keep the pod indefinitely.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..api import Pod
from ..api.types import TAINT_NO_EXECUTE
from ..store import NotFoundError
from .base import Controller


class TaintEvictionController(Controller):
    watch_kinds = ("nodes", "pods")

    def __init__(self, store, clock=None):
        super().__init__(store, clock)
        # pod key -> (eviction deadline, taint-set signature that produced it).
        # The signature lets a taint-set change cancel+reschedule the timed
        # eviction (TimedWorkerQueue semantics) in either direction — a new
        # tighter taint shortens the deadline, removing the tight taint
        # restores the longer one — without the deadline sliding forward on
        # every no-change resync.
        self._deadlines: Dict[str, tuple] = {}

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "nodes":
            return obj.metadata.name
        return f"pod|{obj.key}" if obj.spec.node_name else None

    def tick(self) -> None:
        """Fire due timed evictions (the reference's TimedWorkerQueue)."""
        now = self.clock.now()
        for pod_key, (deadline, _sig) in list(self._deadlines.items()):
            if deadline <= now:
                self._deadlines.pop(pod_key, None)
                self._evict(pod_key)
        # re-examine all tainted nodes so new pods get queued
        nodes, _ = self.store.list("nodes",
                                   lambda n: any(t.effect == TAINT_NO_EXECUTE
                                                 for t in n.spec.taints))
        for n in nodes:
            self._mark(n.metadata.name)
        self.process()

    def sync(self, key: str) -> None:
        if key.startswith("pod|"):
            pod_key = key[4:]
            try:
                pod: Pod = self.store.get("pods", pod_key)
            except NotFoundError:
                self._deadlines.pop(pod_key, None)
                return
            self._check_pod(pod)
            return
        # node key: examine every pod bound to it
        try:
            node = self.store.get("nodes", key)
        except NotFoundError:
            return
        taints = [t for t in node.spec.taints if t.effect == TAINT_NO_EXECUTE]
        pods, _ = self.store.list("pods", lambda p: p.spec.node_name == key
                                  and not p.is_terminal())
        if not taints:
            for p in pods:
                self._deadlines.pop(p.key, None)
            return
        for p in pods:
            self._check_pod(p, node=node)

    def _check_pod(self, pod: Pod, node=None) -> None:
        if node is None:
            try:
                node = self.store.get("nodes", pod.spec.node_name)
            except NotFoundError:
                return
        taints = [t for t in node.spec.taints if t.effect == TAINT_NO_EXECUTE]
        if not taints:
            self._deadlines.pop(pod.key, None)
            return
        # minTolerationSeconds over all taints (getMinTolerationTime): every
        # taint must be tolerated; the tightest tolerationSeconds wins
        min_seconds: Optional[float] = None
        for taint in taints:
            matching = [t for t in pod.spec.tolerations if t.tolerates(taint)]
            if not matching:
                self._deadlines.pop(pod.key, None)
                self._evict(pod.key)
                return
            secs = [t.toleration_seconds for t in matching
                    if t.toleration_seconds is not None]
            if secs:
                s = min(secs)
                min_seconds = s if min_seconds is None else min(min_seconds, s)
        if min_seconds is None:
            self._deadlines.pop(pod.key, None)  # tolerated forever
        else:
            sig = tuple(sorted((t.key, t.value, t.effect) for t in taints))
            existing = self._deadlines.get(pod.key)
            if existing is None or existing[1] != sig:
                # new countdown, or the taint set changed: cancel + reschedule
                # from now with the recomputed minimum (may tighten or loosen)
                self._deadlines[pod.key] = (self.clock.now() + min_seconds, sig)

    def _evict(self, pod_key: str) -> None:
        try:
            self.store.delete("pods", pod_key)
        except NotFoundError:
            pass
