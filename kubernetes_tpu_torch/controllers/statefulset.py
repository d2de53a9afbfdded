"""StatefulSet controller: stable identity, ordinal-ordered rollout, PVC
retention.

The counterpart of `kubernetes_tpu/controllers/statefulset.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller/statefulset/stateful_set_control.go
(UpdateStatefulSet: monotonic create 0..N-1 gated on readiness under
OrderedReady, scale-down from the highest ordinal, one PVC per
volumeClaimTemplate named <template>-<pod>).
"""

from __future__ import annotations

from typing import List, Optional

from ..api import Pod
from ..api.storage import PersistentVolumeClaim, PersistentVolumeClaimSpec
from ..api.types import ObjectMeta, Volume, new_uid
from ..api.workloads import StatefulSet
from ..store import AlreadyExistsError, NotFoundError
from .base import Controller


def sts_owner_ref(sts: StatefulSet) -> dict:
    return {"apiVersion": "apps/v1", "kind": "StatefulSet",
            "name": sts.metadata.name, "uid": sts.metadata.uid, "controller": True}


def _owned(pod: Pod, sts: StatefulSet) -> bool:
    return any(r.get("kind") == "StatefulSet" and r.get("uid") == sts.metadata.uid
               for r in pod.metadata.owner_references)


def _ordinal(pod_name: str, base: str) -> int:
    suffix = pod_name[len(base) + 1:]
    return int(suffix) if suffix.isdigit() else -1


from .revision import REVISION_LABEL  # noqa: F401  (shared fingerprint home)


def revision_hash(sts: StatefulSet) -> str:
    """Template fingerprint — the ControllerRevision name analog
    (pkg/controller/history). Pods carry it in controller-revision-hash."""
    from .revision import revision_name

    return revision_name(sts.metadata.name, sts.spec.template)


class StatefulSetController(Controller):
    watch_kinds = ("statefulsets", "pods")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "statefulsets":
            return obj.key
        for ref in obj.metadata.owner_references:
            if ref.get("kind") == "StatefulSet":
                return f"{obj.metadata.namespace}/{ref['name']}"
        return None

    def sync(self, key: str) -> None:
        try:
            sts: StatefulSet = self.store.get("statefulsets", key)
        except NotFoundError:
            self._delete_owned(key)
            return
        ns, base = sts.metadata.namespace, sts.metadata.name
        pods, _ = self.store.list(
            "pods", lambda p: p.metadata.namespace == ns and _owned(p, sts))
        by_ordinal = {_ordinal(p.metadata.name, base): p for p in pods}
        ordered = sts.spec.pod_management_policy == "OrderedReady"
        rev = revision_hash(sts)

        # scale up / replace missing, in ordinal order; OrderedReady gates each
        # ordinal on the previous one being Running (stateful_set_control.go)
        created_this_pass = False
        for i in range(sts.spec.replicas):
            pod = by_ordinal.get(i)
            if pod is not None and pod.is_terminal():
                # stateful pods are replaced in place, keeping identity
                try:
                    self.store.delete("pods", pod.key)
                except NotFoundError:
                    pass
                pod = None
            if pod is None:
                self._create_pod(sts, i, rev)
                created_this_pass = True
                if ordered:
                    break
            elif ordered and pod.status.phase != "Running":
                break  # wait for readiness before the next ordinal

        # scale down: highest ordinal first, one at a time when ordered
        extra = sorted((o for o in by_ordinal if o >= sts.spec.replicas), reverse=True)
        deleted_this_pass = False
        for o in extra[:1] if ordered else extra:
            try:
                self.store.delete("pods", by_ordinal[o].key)
                deleted_this_pass = True
            except NotFoundError:
                pass

        # rolling update (stateful_set_control.go updateStatefulSet): with
        # RollingUpdate, stale-revision pods at ordinals >= partition are
        # deleted HIGHEST ordinal first, one at a time, each gated on the
        # rest being Running; the replace-missing pass above recreates them
        # with the new template. OnDelete leaves stale pods for the operator.
        if sts.spec.update_strategy == "RollingUpdate":
            stale = sorted(
                (o for o, p in by_ordinal.items()
                 if o >= max(sts.spec.partition, 0) and o < sts.spec.replicas
                 and not p.is_terminal()
                 and p.metadata.labels.get(REVISION_LABEL) != rev),
                reverse=True)
            # every ordinal must exist AND be Running before the next update
            # step, and THIS sync must not have already deleted or created a
            # pod (scale-down or recreate in flight) — at most one member is
            # ever down at a time (OrderedReady's one-at-a-time guarantee)
            all_running = (not created_this_pass
                           and not deleted_this_pass
                           and all(o in by_ordinal for o in range(sts.spec.replicas))
                           and all(p.is_terminal() or p.status.phase == "Running"
                                   for o, p in by_ordinal.items()
                                   if o < sts.spec.replicas))
            if stale and all_running:
                try:
                    self.store.delete("pods", by_ordinal[stale[0]].key)
                except NotFoundError:
                    pass

        current = [p for p in pods if _ordinal(p.metadata.name, base) < sts.spec.replicas
                   and not p.is_terminal()]
        ready = sum(1 for p in current if p.status.phase == "Running")
        updated = sum(1 for p in current
                      if p.metadata.labels.get(REVISION_LABEL) == rev)

        def mutate(obj: StatefulSet) -> StatefulSet:
            obj.status.replicas = len(current)
            obj.status.current_replicas = len(current)
            obj.status.ready_replicas = ready
            obj.status.updated_replicas = updated
            obj.status.update_revision = rev
            obj.status.observed_generation = obj.metadata.generation
            return obj

        try:
            self.store.guaranteed_update("statefulsets", key, mutate)
        except NotFoundError:
            pass

    def _create_pod(self, sts: StatefulSet, ordinal: int, rev: str) -> None:
        name = f"{sts.metadata.name}-{ordinal}"
        pod = sts.spec.template.make_pod(name, sts.metadata.namespace, sts_owner_ref(sts))
        pod.metadata.labels["statefulset.kubernetes.io/pod-name"] = name
        pod.metadata.labels["apps.kubernetes.io/pod-index"] = str(ordinal)
        pod.metadata.labels[REVISION_LABEL] = rev
        # one PVC per volumeClaimTemplate, named <template>-<pod>; reused
        # across pod replacements (identity-preserving storage)
        for tpl in sts.spec.volume_claim_templates:
            tpl_name = (tpl.get("metadata") or {}).get("name", "data")
            claim_name = f"{tpl_name}-{name}"
            self._ensure_pvc(sts.metadata.namespace, claim_name, tpl)
            pod.spec.volumes.append(Volume(name=tpl_name, pvc_claim_name=claim_name))
        try:
            self.store.create("pods", pod)
        except AlreadyExistsError:
            pass

    def _ensure_pvc(self, namespace: str, claim_name: str, tpl: dict) -> None:
        try:
            self.store.get("persistentvolumeclaims", f"{namespace}/{claim_name}")
            return
        except NotFoundError:
            pass
        parsed = PersistentVolumeClaim.from_dict({"metadata": {"name": claim_name},
                                                  "spec": tpl.get("spec") or {}})
        pvc = PersistentVolumeClaim(
            metadata=ObjectMeta(name=claim_name, namespace=namespace, uid=new_uid()),
            spec=PersistentVolumeClaimSpec(
                access_modes=parsed.spec.access_modes or ["ReadWriteOnce"],
                request=parsed.spec.request,
                storage_class_name=parsed.spec.storage_class_name,
            ))
        try:
            self.store.create("persistentvolumeclaims", pvc)
        except AlreadyExistsError:
            pass

    def _delete_owned(self, key: str) -> None:
        ns, name = key.split("/", 1)
        pods, _ = self.store.list(
            "pods", lambda p: p.metadata.namespace == ns and any(
                r.get("kind") == "StatefulSet" and r.get("name") == name
                for r in p.metadata.owner_references))
        for p in pods:
            try:
                self.store.delete("pods", p.key)
            except NotFoundError:
                pass
