"""ServiceAccount + TTL-after-finished controllers.

reference: pkg/controller/serviceaccount/serviceaccounts_controller.go (every
namespace gets a 'default' ServiceAccount) and
pkg/controller/ttlafterfinished/ttlafterfinished_controller.go (finished Jobs
with ttlSecondsAfterFinished are deleted once the TTL elapses).

The counterpart of `kubernetes_tpu/controllers/serviceaccount.py`: the same
behaviour, names and store writes, held equal to it by the port's tests.
"""

from __future__ import annotations

from typing import Optional

from ..api.policy import ServiceAccount
from ..api.types import ObjectMeta, new_uid
from ..store import AlreadyExistsError, NotFoundError
from .base import Controller

# namespaces the apiserver treats as always-existing (admission) — the
# controller materializes their default SA too; server/admission.py imports
# them from here
BOOTSTRAP_NAMESPACES = ("default", "kube-system", "kube-public", "kube-node-lease")


class ServiceAccountController(Controller):
    """Ensures every (non-terminating) namespace has a 'default' SA."""

    watch_kinds = ("namespaces", "serviceaccounts")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "namespaces":
            return obj.metadata.name
        return obj.metadata.namespace  # SA deleted -> recheck its namespace

    def sync_all(self) -> None:
        super().sync_all()
        for ns in BOOTSTRAP_NAMESPACES:
            self._mark(ns)

    def sync(self, name: str) -> None:
        if name not in BOOTSTRAP_NAMESPACES:
            try:
                ns = self.store.get("namespaces", name)
            except NotFoundError:
                return
            if ns.metadata.deletion_timestamp is not None:
                return
        try:
            self.store.get("serviceaccounts", f"{name}/default")
        except NotFoundError:
            try:
                self.store.create("serviceaccounts", ServiceAccount(
                    metadata=ObjectMeta(name="default", namespace=name,
                                        uid=new_uid())))
            except AlreadyExistsError:
                pass


class TTLAfterFinishedController(Controller):
    """Deletes finished Jobs whose ttlSecondsAfterFinished has elapsed.
    Unexpired jobs park in a local timer map instead of re-marking themselves
    (the reference's workqueue AddAfter), so the loop stays idle between
    expiries."""

    watch_kinds = ("jobs",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._pending_ttl = {}  # job key -> expiry timestamp

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        return obj.key

    def reconcile_once(self) -> int:
        now = self.clock.now()
        for key, exp in list(self._pending_ttl.items()):
            if now >= exp:
                # keep the entry: sync() consults it for the legacy
                # (timestamp-less) path and pops it on deletion
                self._mark(key)
        return super().reconcile_once()

    def _finished_at(self, job) -> Optional[float]:
        for c in job.status.conditions:  # dicts (workloads.JobStatus)
            if c.get("type") in ("Complete", "Failed") and c.get("status") == "True":
                return (job.status.completion_time
                        or c.get("lastTransitionTime") or 0.0)
        return None

    def sync(self, key: str) -> None:
        try:
            job = self.store.get("jobs", key)
        except NotFoundError:
            self._pending_ttl.pop(key, None)
            return
        ttl = job.spec.ttl_seconds_after_finished
        if ttl is None:
            self._pending_ttl.pop(key, None)
            return
        finished = self._finished_at(job)
        if finished is None:
            self._pending_ttl.pop(key, None)  # condition cleared: stop timing
            return
        if not finished:
            # a terminal condition without a timestamp (legacy object): count
            # the TTL from first observation instead of deleting immediately
            expire = self._pending_ttl.get(key)
            if expire is None:
                self._pending_ttl[key] = self.clock.now() + ttl
                return
        else:
            expire = finished + ttl
        if self.clock.now() >= expire:
            self._pending_ttl.pop(key, None)
            try:
                self.store.delete("jobs", key)
            except NotFoundError:
                pass
        else:
            self._pending_ttl[key] = expire  # AddAfter analog


class EventTTLController(Controller):
    """Expires Event objects after event_ttl (reference: kube-apiserver's
    --event-ttl, default 1h, enforced by etcd leases; here a sweep controller
    since the store has no per-object TTLs). Same timer-map pattern as
    TTLAfterFinished — no busy loops between expiries."""

    watch_kinds = ("events",)

    def __init__(self, *a, event_ttl: float = 3600.0, **kw):
        super().__init__(*a, **kw)
        self.event_ttl = event_ttl
        self._pending: dict = {}  # event key -> expiry

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def reconcile_once(self) -> int:
        now = self.clock.now()
        for key, exp in list(self._pending.items()):
            if now >= exp:
                self._mark(key)
        return super().reconcile_once()

    def sync(self, key: str) -> None:
        try:
            ev = self.store.get("events", key)
        except NotFoundError:
            self._pending.pop(key, None)
            return
        expire = (ev.last_timestamp or self.clock.now()) + self.event_ttl
        if self.clock.now() >= expire:
            self._pending.pop(key, None)
            try:
                self.store.delete("events", key)
            except NotFoundError:
                pass
        else:
            self._pending[key] = expire
