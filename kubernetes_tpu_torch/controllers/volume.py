"""Volume controllers: PV↔PVC binding and attach/detach, OUTSIDE the
scheduling cycle.

reference:
  - pkg/controller/volume/persistentvolume/pv_controller.go — the binder:
    an unbound PVC finds its smallest satisfying Available PV and both
    sides commit together; a user-pre-bound PV completes its claim; a
    deleted claim releases its PV (Released phase, reclaim policy Delete
    deletes it). WaitForFirstConsumer classes are left to the scheduler's
    VolumeBinding plugin (plugins/volume.py Reserve/PreBind), exactly as
    the reference's binder skips un-annotated WFFC claims.
  - pkg/controller/volume/attachdetach/attach_detach_controller.go — the
    attach/detach reconciler: desired state = every (PV, node) pair some
    scheduled pod's bound PVC points at; actual state = VolumeAttachment
    objects. Missing attachments are created (and attached synchronously —
    this controller IS the attach backend for the fake runtime), stale
    ones detached.

The counterpart of `kubernetes_tpu/controllers/volume.py`: the same
behaviour, names and store writes, held equal to it by the port's tests.
"""

from __future__ import annotations

from typing import Optional

from ..api.storage import (
    BINDING_WAIT_FOR_FIRST_CONSUMER,
    CLAIM_BOUND,
    VOLUME_AVAILABLE,
    VOLUME_BOUND,
    VOLUME_RELEASED,
    VolumeAttachment,
)
from ..store import AlreadyExistsError, NotFoundError
from .base import Controller


class PersistentVolumeBinder(Controller):
    """pv_controller.go's ClaimWorker + VolumeWorker collapsed into one
    level-triggered reconciler (keys: "pvc:ns/name" / "pv:name")."""

    watch_kinds = ("persistentvolumeclaims", "persistentvolumes",
                   "storageclasses")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "persistentvolumeclaims":
            if obj.spec.volume_name:
                # a (possibly DELETED) bound claim must resync its PV —
                # that's the release path; the claim key alone would
                # dead-end on NotFound
                self._mark(f"pv:{obj.spec.volume_name}")
            return f"pvc:{obj.metadata.namespace}/{obj.metadata.name}"
        if kind == "persistentvolumes":
            return f"pv:{obj.metadata.name}"
        # a StorageClass change can unblock any pending claim
        self._mark_all_pending_claims()
        return None

    def _mark_all_pending_claims(self) -> None:
        claims, _ = self.store.list(
            "persistentvolumeclaims", lambda c: not c.spec.volume_name)
        for c in claims:
            self._mark(f"pvc:{c.key}")

    def _class_of(self, claim):
        """Resolve the claim's StorageClass (None = no class semantics)."""
        name = claim.spec.storage_class_name
        if name is None:
            classes, _ = self.store.list("storageclasses",
                                         lambda c: c.is_default)
            if not classes:
                return None
            return max(classes, key=lambda c: c.metadata.creation_timestamp)
        if name == "":
            return None
        try:
            return self.store.get("storageclasses", name)
        except NotFoundError:
            return None

    def sync(self, key: str) -> None:
        kind, _, rest = key.partition(":")
        if kind == "pvc":
            self._sync_claim(rest)
        else:
            self._sync_volume(rest)

    def _sync_claim(self, key: str) -> None:
        try:
            claim = self.store.get("persistentvolumeclaims", key)
        except NotFoundError:
            return
        if claim.spec.volume_name:
            # Bound only when the named PV exists and isn't taken by another
            # claim (a claim naming a missing volume stays Pending — the
            # reference keeps it Pending/Lost, never usable)
            try:
                pv = self.store.get("persistentvolumes",
                                    claim.spec.volume_name)
            except NotFoundError:
                return
            if pv.spec.claim_ref and pv.spec.claim_ref != claim.key:
                return
            if not pv.spec.claim_ref or pv.phase != VOLUME_BOUND:
                def bind_pv(p):
                    p.spec.claim_ref = claim.key
                    p.phase = VOLUME_BOUND
                    return p

                self.store.guaranteed_update(
                    "persistentvolumes", claim.spec.volume_name, bind_pv)
            if claim.phase != CLAIM_BOUND:
                def mark_bound(c):
                    c.phase = CLAIM_BOUND
                    return c

                self.store.guaranteed_update("persistentvolumeclaims", key,
                                             mark_bound)
            return
        sc = self._class_of(claim)
        if sc is not None and \
                sc.volume_binding_mode == BINDING_WAIT_FOR_FIRST_CONSUMER:
            return  # the scheduler's VolumeBinding plugin owns WFFC claims
        wanted_class = sc.metadata.name if sc is not None else \
            (claim.spec.storage_class_name or "")
        modes = set(claim.spec.access_modes)

        def matches(pv):
            if pv.phase != VOLUME_AVAILABLE:
                return False
            if pv.spec.claim_ref and pv.spec.claim_ref != claim.key:
                return False
            if pv.spec.storage_class_name != wanted_class:
                return False
            if not modes.issubset(set(pv.spec.access_modes)):
                return False
            return pv.spec.capacity >= claim.spec.request

        pvs, _ = self.store.list("persistentvolumes", matches)
        if not pvs:
            return
        # user-pre-bound volume wins; otherwise smallest satisfying fit
        # (pv_controller's findBestMatchForClaim order)
        pre = [pv for pv in pvs if pv.spec.claim_ref == claim.key]
        chosen = pre[0] if pre else min(pvs, key=lambda p: p.spec.capacity)
        with self.store.transaction():
            def bind_pv(pv):
                if pv.spec.claim_ref and pv.spec.claim_ref != claim.key:
                    raise NotFoundError("pv was bound concurrently")
                pv.spec.claim_ref = claim.key
                pv.phase = VOLUME_BOUND
                return pv

            def bind_claim(c):
                c.spec.volume_name = chosen.metadata.name
                c.phase = CLAIM_BOUND
                return c

            try:
                self.store.guaranteed_update("persistentvolumes",
                                             chosen.metadata.name, bind_pv)
            except NotFoundError:
                self._mark(f"pvc:{key}")  # raced; retry with a fresh list
                return
            self.store.guaranteed_update("persistentvolumeclaims", key,
                                         bind_claim)

    def _sync_volume(self, name: str) -> None:
        try:
            pv = self.store.get("persistentvolumes", name)
        except NotFoundError:
            return
        if not pv.spec.claim_ref:
            # a newly-appeared PV may be the one a user-prebound claim names
            claims, _ = self.store.list(
                "persistentvolumeclaims",
                lambda c: c.spec.volume_name == name
                and c.phase != CLAIM_BOUND)
            for c in claims:
                self._mark(f"pvc:{c.key}")
            return
        try:
            claim = self.store.get("persistentvolumeclaims",
                                   pv.spec.claim_ref)
        except NotFoundError:
            claim = None
        if claim is None:
            if pv.phase == VOLUME_AVAILABLE:
                # user-pre-bound PV whose claim does not exist YET: stays
                # Available waiting for it (pv_controller keeps a
                # claimRef-with-empty-UID volume Available, not Released)
                return
            # released: the claim is gone (pv_controller reclaimVolume)
            if pv.spec.reclaim_policy == "Delete":
                try:
                    self.store.delete("persistentvolumes", name)
                except NotFoundError:
                    pass
                return
            if pv.phase != VOLUME_RELEASED:
                def release(p):
                    p.phase = VOLUME_RELEASED
                    return p

                self.store.guaranteed_update("persistentvolumes", name,
                                             release)
            return
        if not claim.spec.volume_name:
            # user pre-bound this PV to the claim: complete the other side
            self._mark(f"pvc:{claim.key}")
        elif pv.phase != VOLUME_BOUND and claim.spec.volume_name == name:
            def mark_bound(p):
                p.phase = VOLUME_BOUND
                return p

            self.store.guaranteed_update("persistentvolumes", name,
                                         mark_bound)


def attachment_name(pv_name: str, node_name: str) -> str:
    return f"va-{pv_name}-{node_name}"


class AttachDetachController(Controller):
    """Whole-state reconcile (the reference's DesiredStateOfWorld vs
    ActualStateOfWorld populators + reconciler, collapsed): one sync pass
    diffs desired (PV, node) pairs against live VolumeAttachments."""

    watch_kinds = ("pods", "persistentvolumeclaims", "volumeattachments")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        return "sync"

    def sync(self, key: str) -> None:
        # predicate pre-filters BEFORE the store's list-copy: only
        # volume-bearing pods pay the copy, not the whole running population
        pods, _ = self.store.list(
            "pods", lambda p: bool(p.spec.node_name) and not p.is_terminal()
            and any(v.pvc_claim_name for v in p.spec.volumes))
        desired = {}
        for pod in pods:
            for vol in pod.spec.volumes:
                if not vol.pvc_claim_name:
                    continue
                try:
                    claim = self.store.get(
                        "persistentvolumeclaims",
                        f"{pod.metadata.namespace}/{vol.pvc_claim_name}")
                except NotFoundError:
                    continue
                if not claim.spec.volume_name:
                    continue
                desired[(claim.spec.volume_name, pod.spec.node_name)] = True
        attachments, _ = self.store.list("volumeattachments")
        actual = {(va.pv_name, va.node_name): va for va in attachments}
        for (pv_name, node), _w in desired.items():
            if (pv_name, node) in actual:
                continue
            try:
                pv = self.store.get("persistentvolumes", pv_name)
                attacher = pv.spec.csi_driver or "kubernetes.io/in-tree"
            except NotFoundError:
                attacher = "kubernetes.io/in-tree"
            va = VolumeAttachment(attacher=attacher, node_name=node,
                                  pv_name=pv_name, attached=True)
            va.metadata.name = attachment_name(pv_name, node)
            try:
                self.store.create("volumeattachments", va)
            except AlreadyExistsError:
                pass  # another pass won the race; anything else propagates
                # to process()'s retry path
        for (pv_name, node), va in actual.items():
            if (pv_name, node) not in desired:
                try:
                    self.store.delete("volumeattachments", va.metadata.name)
                except NotFoundError:
                    pass
