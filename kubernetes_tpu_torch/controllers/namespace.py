"""Namespace lifecycle controller: terminating namespaces drain their contents.

reference: pkg/controller/namespace/deletion/namespaced_resources_deleter.go —
a namespace with a deletionTimestamp is swept: every namespaced object in it is
deleted; once empty, the namespace itself is removed (finalizer semantics
collapsed to the observable behavior).

The counterpart of `kubernetes_tpu/controllers/namespace.py`: the same
behaviour, names and store writes, held equal to it by the port's tests.
"""

from __future__ import annotations

from typing import Optional

from ..store import NotFoundError
from .base import Controller


class NamespaceController(Controller):
    watch_kinds = ("namespaces",)

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        return obj.metadata.name

    def sync(self, name: str) -> None:
        try:
            ns = self.store.get("namespaces", name)
        except NotFoundError:
            return
        if ns.metadata.deletion_timestamp is None:
            return
        remaining = 0
        for kind in list(self.store.kinds()):
            if kind == "namespaces":
                continue
            objs, _ = self.store.list(
                kind, lambda o: getattr(o.metadata, "namespace", "") == name)
            for obj in objs:
                try:
                    self.store.delete(kind, self.store.object_key(obj))
                except NotFoundError:
                    pass
                else:
                    remaining += 1
        if remaining == 0:
            try:
                self.store.delete("namespaces", name)
            except NotFoundError:
                pass
        else:
            self._mark(name)  # requeue until empty

    def mark_terminating(self, name: str) -> None:
        """kubectl delete namespace equivalent: stamp deletionTimestamp."""
        def mutate(ns):
            if ns.metadata.deletion_timestamp is None:
                ns.metadata.deletion_timestamp = self.clock.now()
            return ns

        self.store.guaranteed_update("namespaces", name, mutate)
        self._mark(name)
