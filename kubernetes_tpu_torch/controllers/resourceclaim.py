"""DRA resourceclaim controller: template → generated claims + orphan reap.

reference: pkg/controller/resourceclaim/controller.go — for every pod
resourceClaims entry naming a ResourceClaimTemplate, a ResourceClaim
`<pod>-<ref>` is generated (owned by the pod, stamped with the template's
device requests) and recorded in pod.status.resourceClaimStatuses; the
scheduler's DynamicResources plugin resolves template refs through that
status map. Generated claims whose owner pod is gone (or terminal) are
reaped — ownerReferences would let the GC collect them eventually, but the
reference's controller deletes deterministically and so does this one.

The counterpart of `kubernetes_tpu/controllers/resourceclaim.py`: the same
behaviour, names and store writes, held equal to it by the port's tests.
"""

from __future__ import annotations

from typing import Optional

from ..api.dra import ResourceClaim
from ..store import AlreadyExistsError, NotFoundError
from .base import Controller

# annotation marking a generated claim (reference:
# resourceclaim.PodClaimName annotation "resource.kubernetes.io/pod-claim-name")
POD_CLAIM_NAME = "resource.kubernetes.io/pod-claim-name"


def claim_name_for(pod_name: str, ref: str) -> str:
    return f"{pod_name}-{ref}"


class ResourceClaimController(Controller):
    watch_kinds = ("pods", "resourceclaims")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "pods":
            spec = getattr(obj, "spec", None)
            if spec is None or not spec.resource_claim_templates:
                return None
            # a (possibly DELETED/terminal) pod must resync its generated
            # claims — that's the reap path
            ns = obj.metadata.namespace
            for _ref, cn in obj.status.resource_claim_statuses.items():
                self._mark(f"claim:{ns}/{cn}")
            return f"pod:{ns}/{obj.metadata.name}"
        if POD_CLAIM_NAME in (obj.metadata.annotations or {}):
            return f"claim:{obj.metadata.namespace}/{obj.metadata.name}"
        return None

    def sync(self, key: str) -> None:
        kind, _, rest = key.partition(":")
        if kind == "pod":
            self._sync_pod(rest)
        else:
            self._sync_claim(rest)

    def _sync_pod(self, key: str) -> None:
        try:
            pod = self.store.get("pods", key)
        except NotFoundError:
            return
        if pod.is_terminal() or not pod.spec.resource_claim_templates:
            return
        ns = pod.metadata.namespace
        created = {}
        for ref, tmpl_name in pod.spec.resource_claim_templates:
            generated = pod.status.resource_claim_statuses.get(ref)
            if generated:
                try:
                    self.store.get("resourceclaims", f"{ns}/{generated}")
                    continue  # already generated and alive
                except NotFoundError:
                    pass  # stamped but deleted: regenerate
            try:
                tmpl = self.store.get("resourceclaimtemplates",
                                      f"{ns}/{tmpl_name}")
            except NotFoundError:
                continue  # template not created yet; retried on its ADDED
            claim = ResourceClaim(requests=list(tmpl.requests))
            claim.metadata.name = claim_name_for(pod.metadata.name, ref)
            claim.metadata.namespace = ns
            claim.metadata.annotations[POD_CLAIM_NAME] = ref
            claim.metadata.owner_references = [{
                "apiVersion": "v1", "kind": "Pod",
                "name": pod.metadata.name, "uid": pod.metadata.uid,
                "controller": True,
            }]
            try:
                self.store.create("resourceclaims", claim)
            except AlreadyExistsError:
                # adopt ONLY a claim this exact pod incarnation owns — a
                # stale same-name claim (recreated pod, cross-pod name
                # collision) must not be stamped into status; the reap
                # path deletes it and re-marks this pod to regenerate
                existing = self.store.get("resourceclaims",
                                          f"{ns}/{claim.metadata.name}")
                owner = next((o for o in existing.metadata.owner_references
                              if o.get("kind") == "Pod"), {})
                if owner.get("uid") != pod.metadata.uid:
                    self._mark(f"claim:{ns}/{claim.metadata.name}")
                    continue
            created[ref] = claim.metadata.name
        if created:
            def stamp(p):
                p.status.resource_claim_statuses.update(created)
                return p

            try:
                self.store.guaranteed_update("pods", key, stamp)
            except NotFoundError:
                pass

    def _sync_claim(self, key: str) -> None:
        """Reap generated claims whose owning pod is gone or terminal."""
        try:
            claim = self.store.get("resourceclaims", key)
        except NotFoundError:
            return
        owner = next((o for o in claim.metadata.owner_references
                      if o.get("kind") == "Pod"), None)
        if owner is None:
            return
        ns = claim.metadata.namespace
        try:
            pod = self.store.get("pods", f"{ns}/{owner.get('name', '')}")
        except NotFoundError:
            pod = None
        if pod is not None and pod.metadata.uid == owner.get("uid") \
                and not pod.is_terminal():
            return
        try:
            self.store.delete("resourceclaims", key)
        except NotFoundError:
            pass
        if pod is not None and not pod.is_terminal():
            # a same-name recreated pod was blocked by the stale claim:
            # regenerate for the new incarnation
            self._mark(f"pod:{ns}/{pod.metadata.name}")

    _RESYNC_EVERY = 200  # reconcile rounds between full sweeps (~10s idle)

    def reconcile_once(self) -> int:
        n = super().reconcile_once()
        self._resync_tick = getattr(self, "_resync_tick", 0) + 1
        if self._resync_tick >= self._RESYNC_EVERY:
            self._resync_tick = 0
            n += self.reap_orphans()
        return n

    def reap_orphans(self) -> int:
        """Full-store sweep (the controller's periodic resync, driven by
        reconcile_once every _RESYNC_EVERY rounds): every generated claim is
        re-checked against its owner — the backstop for DELETED events lost
        to a watch eviction."""
        claims, _ = self.store.list(
            "resourceclaims",
            lambda c: POD_CLAIM_NAME in (c.metadata.annotations or {}))
        for c in claims:
            self._mark(f"claim:{c.key}")
        return self.process()
