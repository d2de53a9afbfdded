"""ReplicaSet controller.

The counterpart of `kubernetes_tpu/controllers/replicaset.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller/replicaset/replica_set.go:677 syncReplicaSet —
level-triggered convergence of matching-pod count to spec.replicas, with
ownerReference adoption and surplus deletion (youngest first).
"""

from __future__ import annotations

from typing import List, Optional

from ..api import Pod
from ..api.workloads import ReplicaSet
from ..store import NotFoundError
from .base import Controller


def owner_ref(rs: ReplicaSet) -> dict:
    return {
        "kind": "ReplicaSet",
        "name": rs.metadata.name,
        "uid": rs.metadata.uid,
        "controller": True,
    }


def is_owned_by(pod: Pod, rs: ReplicaSet) -> bool:
    return any(
        ref.get("kind") == "ReplicaSet" and ref.get("uid") == rs.metadata.uid
        for ref in pod.metadata.owner_references
    )


class ReplicaSetController(Controller):
    watch_kinds = ("replicasets", "pods")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "replicasets":
            return obj.key
        # pod events resolve to their owning ReplicaSet (resolveControllerRef)
        for ref in obj.metadata.owner_references:
            if ref.get("kind") == "ReplicaSet":
                return f"{obj.metadata.namespace}/{ref['name']}"
        return None

    def sync(self, key: str) -> None:
        try:
            rs: ReplicaSet = self.store.get("replicasets", key)
        except NotFoundError:
            self._delete_orphans(key)
            return
        ns = rs.metadata.namespace
        pods, _ = self.store.list(
            "pods",
            lambda p: p.metadata.namespace == ns
            and is_owned_by(p, rs)
            and not p.is_terminal()
            and p.metadata.deletion_timestamp is None,
        )
        diff = rs.spec.replicas - len(pods)
        if diff > 0:
            self._create_pods(rs, diff)
        elif diff < 0:
            self._delete_pods(rs, pods, -diff)
        # status update (observedGeneration + replica counts)
        ready = sum(1 for p in pods if p.status.phase == "Running")

        def mutate(obj: ReplicaSet) -> ReplicaSet:
            obj.status.replicas = len(pods) + max(diff, 0)
            obj.status.ready_replicas = ready
            obj.status.observed_generation = obj.metadata.generation
            return obj

        try:
            self.store.guaranteed_update("replicasets", key, mutate)
        except NotFoundError:
            pass

    def _create_pods(self, rs: ReplicaSet, n: int) -> None:
        from ..store import AlreadyExistsError

        base = rs.metadata.name
        i = 0
        created = 0
        while created < n:
            name = f"{base}-{rs.metadata.uid[-5:]}-{i}"
            i += 1
            pod = rs.spec.template.make_pod(name, rs.metadata.namespace, owner_ref(rs))
            try:
                self.store.create("pods", pod)
                created += 1
            except AlreadyExistsError:
                continue  # name taken (e.g. terminal pod not yet GC'd): next index

    def _delete_pods(self, rs: ReplicaSet, pods: List[Pod], n: int) -> None:
        # delete unscheduled first, then youngest (getPodsToDelete ranking, simplified)
        ranked = sorted(pods, key=lambda p: (bool(p.spec.node_name), -p.metadata.creation_timestamp,
                                             -p.metadata.resource_version))
        for p in ranked[:n]:
            try:
                self.store.delete("pods", p.key)
            except NotFoundError:
                pass

    def _delete_orphans(self, key: str) -> None:
        """RS deleted: cascade-delete its pods (GC's ownerReference cleanup)."""
        ns, name = key.split("/", 1)
        pods, _ = self.store.list(
            "pods",
            lambda p: p.metadata.namespace == ns and any(
                r.get("kind") == "ReplicaSet" and r.get("name") == name
                for r in p.metadata.owner_references
            ),
        )
        for p in pods:
            try:
                self.store.delete("pods", p.key)
            except NotFoundError:
                pass
