"""Deployment controller — manages ReplicaSets per template revision.

The counterpart of `kubernetes_tpu/controllers/deployment.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller/deployment (syncDeployment, rolling.go). Semantics:
one ReplicaSet per pod-template hash; RollingUpdate scales the new RS up and
old RSes down within maxSurge/maxUnavailable; Recreate scales old to 0 first.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

from ..api.workloads import Deployment, ReplicaSet, ReplicaSetSpec
from ..api.types import ObjectMeta, new_uid
from ..store import AlreadyExistsError, NotFoundError
from .base import Controller


def template_hash(dep: Deployment) -> str:
    from .revision import template_fingerprint

    return template_fingerprint(dep.spec.template)


# revision bookkeeping (deployment/util/deployment_util.go Revision/
# SetNewReplicaSetAnnotations): each template generation gets a monotonically
# increasing revision on its RS; rollbacks re-activate an old RS's template,
# which then receives the NEW max revision
REVISION_ANNOTATION = "deployment.kubernetes.io/revision"


def rs_revision(rs: ReplicaSet) -> int:
    try:
        return int(rs.metadata.annotations.get(REVISION_ANNOTATION, "0"))
    except ValueError:
        return 0


def is_owned_by_dep(rs: ReplicaSet, dep: Deployment) -> bool:
    return any(
        ref.get("kind") == "Deployment" and ref.get("uid") == dep.metadata.uid
        for ref in rs.metadata.owner_references
    )


class DeploymentController(Controller):
    watch_kinds = ("deployments", "replicasets")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "deployments":
            return obj.key
        for ref in obj.metadata.owner_references:
            if ref.get("kind") == "Deployment":
                return f"{obj.metadata.namespace}/{ref['name']}"
        return None

    def sync(self, key: str) -> None:
        try:
            dep: Deployment = self.store.get("deployments", key)
        except NotFoundError:
            self._delete_owned(key)
            return
        new_rs, old_rses = self._get_or_create_rses(dep)
        if dep.spec.strategy == "Recreate":
            self._sync_recreate(dep, new_rs, old_rses)
        else:
            self._sync_rolling(dep, new_rs, old_rses)
        self._update_status(dep, new_rs, old_rses)

    # -- RS management ---------------------------------------------------------

    def _get_or_create_rses(self, dep: Deployment) -> Tuple[ReplicaSet, List[ReplicaSet]]:
        h = template_hash(dep)
        rses, _ = self.store.list(
            "replicasets",
            lambda rs: rs.metadata.namespace == dep.metadata.namespace and is_owned_by_dep(rs, dep),
        )
        new_rs = None
        old = []
        for rs in rses:
            if rs.metadata.labels.get("pod-template-hash") == h:
                new_rs = rs
            else:
                old.append(rs)
        max_rev = max((rs_revision(rs) for rs in rses), default=0)
        if new_rs is not None and old and rs_revision(new_rs) < max_rev:
            # rollback: an OLD template became current again — it takes the
            # next revision so history stays monotonic (deployment_util.go)
            def bump(obj: ReplicaSet) -> ReplicaSet:
                obj.metadata.annotations[REVISION_ANNOTATION] = str(max_rev + 1)
                return obj

            new_rs = self.store.guaranteed_update("replicasets", new_rs.key, bump)
        if new_rs is None:
            import copy

            template = copy.deepcopy(dep.spec.template)
            template.metadata.labels["pod-template-hash"] = h
            new_rs = ReplicaSet(
                metadata=ObjectMeta(
                    name=f"{dep.metadata.name}-{h}",
                    namespace=dep.metadata.namespace,
                    uid=new_uid(),
                    labels={**template.metadata.labels},
                    annotations={REVISION_ANNOTATION: str(max_rev + 1)},
                    owner_references=[{
                        "kind": "Deployment",
                        "name": dep.metadata.name,
                        "uid": dep.metadata.uid,
                        "controller": True,
                    }],
                ),
                spec=ReplicaSetSpec(replicas=0, selector=dep.spec.selector, template=template),
            )
            try:
                new_rs = self.store.create("replicasets", new_rs)
            except AlreadyExistsError:
                new_rs = self.store.get("replicasets", new_rs.key)
        return new_rs, old

    def _scale(self, rs: ReplicaSet, replicas: int) -> None:
        if rs.spec.replicas == replicas:
            return

        def mutate(obj: ReplicaSet) -> ReplicaSet:
            obj.spec.replicas = replicas
            return obj

        self.store.guaranteed_update("replicasets", rs.key, mutate)

    # -- strategies ------------------------------------------------------------

    def _sync_recreate(self, dep, new_rs, old_rses) -> None:
        old_total = sum(rs.spec.replicas for rs in old_rses)
        if old_total > 0:
            for rs in old_rses:
                self._scale(rs, 0)
            return  # next sync (triggered by RS events) scales the new one up
        self._scale(new_rs, dep.spec.replicas)

    def _sync_rolling(self, dep, new_rs, old_rses) -> None:
        desired = dep.spec.replicas
        max_total = desired + dep.spec.max_surge
        old_total = sum(rs.spec.replicas for rs in old_rses)
        if new_rs.spec.replicas > desired:
            # deployment scaled down: shrink the new RS directly
            self._scale(new_rs, desired)
            new_rs.spec.replicas = desired
        # scale up new within surge budget
        new_target = min(desired, max_total - old_total)
        if new_target > new_rs.spec.replicas:
            self._scale(new_rs, new_target)
        # scale down old as new pods become ready (simplified readiness: running)
        new_ready = self._ready_count(new_rs)
        min_available = desired - dep.spec.max_unavailable
        can_remove = max(0, old_total + new_ready - min_available)
        for rs in sorted(old_rses, key=lambda r: r.metadata.name):
            if can_remove <= 0:
                break
            cut = min(rs.spec.replicas, can_remove)
            if cut > 0:
                self._scale(rs, rs.spec.replicas - cut)
                can_remove -= cut

    def _ready_count(self, rs: ReplicaSet) -> int:
        pods, _ = self.store.list(
            "pods",
            lambda p: p.metadata.namespace == rs.metadata.namespace and any(
                r.get("kind") == "ReplicaSet" and r.get("uid") == rs.metadata.uid
                for r in p.metadata.owner_references
            ) and p.status.phase == "Running",
        )
        return len(pods)

    def _update_status(self, dep, new_rs, old_rses) -> None:
        def mutate(obj: Deployment) -> Deployment:
            obj.status.replicas = new_rs.spec.replicas + sum(r.spec.replicas for r in old_rses)
            obj.status.updated_replicas = new_rs.spec.replicas
            obj.status.ready_replicas = self._ready_count(new_rs)
            obj.status.observed_generation = obj.metadata.generation
            return obj

        try:
            self.store.guaranteed_update("deployments", dep.key, mutate)
        except NotFoundError:
            pass

    def _delete_owned(self, key: str) -> None:
        ns, name = key.split("/", 1)
        rses, _ = self.store.list(
            "replicasets",
            lambda rs: rs.metadata.namespace == ns and any(
                r.get("kind") == "Deployment" and r.get("name") == name
                for r in rs.metadata.owner_references
            ),
        )
        for rs in rses:
            try:
                self.store.delete("replicasets", rs.key)
            except NotFoundError:
                pass
