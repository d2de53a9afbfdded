"""Garbage collector: ownerReference-based cascading deletion.

The counterpart of `kubernetes_tpu/controllers/garbagecollector.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller/garbagecollector/garbagecollector.go — builds a
dependency graph from ownerReferences and deletes dependents whose controller
owner is gone (background cascading deletion). This implementation rescans the
store's object graph per sync round instead of maintaining the graph
incrementally; same observable behavior on delete.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..store import NotFoundError
from .base import Controller

# kinds that carry ownerReferences worth scanning, and where their owners live
KIND_OF = {
    "ReplicaSet": "replicasets",
    "Deployment": "deployments",
    "StatefulSet": "statefulsets",
    "DaemonSet": "daemonsets",
    "Job": "jobs",
    "CronJob": "cronjobs",
    "Pod": "pods",
    "Service": "services",
}


class GarbageCollector(Controller):
    watch_kinds = ("pods", "replicasets", "jobs", "endpointslices",
                   "persistentvolumeclaims")

    SWEEP_INTERVAL = 30.0

    def __init__(self, store, clock=None):
        super().__init__(store, clock)
        self._last_sweep = float("-inf")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if obj.metadata.owner_references:
            return f"{kind}|{self.store.object_key(obj)}"
        return None

    def reconcile_once(self) -> int:
        """Event-driven marks plus a periodic full-store sweep: owner DELETION
        does not emit events on the dependents (podlogs, orphaned pods), so
        only the graph resync catches them (the reference GC's absentOwnerCache
        + monitor resync)."""
        n = super().reconcile_once()
        if self.clock.now() - self._last_sweep >= self.SWEEP_INTERVAL:
            self._last_sweep = self.clock.now()
            n += self.sweep()
        return n

    def sweep(self) -> int:
        """Full-store orphan scan (the GC's graph resync). Returns #deleted."""
        deleted = 0
        for kind in list(self.store.kinds()):
            objs, _ = self.store.list(kind)
            for obj in objs:
                if self._is_orphan(obj):
                    if self._delete(kind, self.store.object_key(obj)):
                        deleted += 1
        return deleted

    def sync(self, key: str) -> None:
        kind, _, obj_key = key.partition("|")
        try:
            obj = self.store.get(kind, obj_key)
        except NotFoundError:
            return
        if self._is_orphan(obj):
            self._delete(kind, obj_key)

    def _owner_exists(self, namespace: str, ref: Dict) -> bool:
        owner_kind = KIND_OF.get(ref.get("kind", ""))
        if owner_kind is None:
            return True  # unknown owner kinds are left alone (virtual nodes)
        key = f"{namespace}/{ref['name']}" if namespace else ref["name"]
        try:
            owner = self.store.get(owner_kind, key)
        except NotFoundError:
            return False
        # uid must match: a recreated same-name owner does not adopt (gc graph)
        return not ref.get("uid") or owner.metadata.uid == ref["uid"]

    def _is_orphan(self, obj) -> bool:
        refs = obj.metadata.owner_references
        if not refs:
            return False
        controller_refs = [r for r in refs if r.get("controller")] or refs
        return not any(self._owner_exists(obj.metadata.namespace, r)
                       for r in controller_refs)

    def _delete(self, kind: str, key: str) -> bool:
        try:
            self.store.delete(kind, key)
            return True
        except NotFoundError:
            return False
