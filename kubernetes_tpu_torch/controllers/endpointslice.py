"""EndpointSlice controller: Service selector -> endpoint slices.

reference: pkg/controller/endpointslice/reconciler.go — one or more slices per
Service (capped at maxEndpointsPerSlice), endpoints from Running pods matching
the selector, ready = pod Running; target/port resolution from servicePorts.
Pod IPs are synthesized from the pod uid (this build has no real pod network).

The counterpart of `kubernetes_tpu/controllers/endpointslice.py`: the same
behaviour, names and store writes, held equal to it by the port's tests.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

from ..api import Pod
from ..api.networking import Endpoint, EndpointSlice, Service
from ..api.types import ObjectMeta, new_uid
from ..store import AlreadyExistsError, NotFoundError
from .base import Controller


def pod_ip(pod: Pod) -> str:
    """Deterministic synthetic 10.x.y.z address from the pod uid."""
    h = hashlib.sha1(pod.metadata.uid.encode()).digest()
    return f"10.{h[0]}.{h[1]}.{max(h[2], 1)}"


def svc_owner_ref(svc: Service) -> dict:
    return {"apiVersion": "v1", "kind": "Service", "name": svc.metadata.name,
            "uid": svc.metadata.uid, "controller": True}


class EndpointSliceController(Controller):
    watch_kinds = ("services", "pods")

    def __init__(self, store, clock=None,
                 max_endpoints_per_slice: int = EndpointSlice.MAX_ENDPOINTS):
        super().__init__(store, clock)
        self.max_endpoints = max_endpoints_per_slice

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "services":
            return obj.key
        # pod events resync every service in the namespace (the reference maps
        # pod -> services via a selector cache)
        return f"{obj.metadata.namespace}/*"

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        if name == "*":
            services, _ = self.store.list(
                "services", lambda s: s.metadata.namespace == ns)
            for svc in services:
                self._reconcile(svc)
            return
        try:
            svc: Service = self.store.get("services", key)
        except NotFoundError:
            self._delete_slices(ns, name)
            return
        self._reconcile(svc)

    def _reconcile(self, svc: Service) -> None:
        ns = svc.metadata.namespace
        want: List[Endpoint] = []
        if svc.spec.selector:
            pods, _ = self.store.list(
                "pods", lambda p: p.metadata.namespace == ns and not p.is_terminal()
                and all(p.metadata.labels.get(k) == v
                        for k, v in svc.spec.selector.items()))
            pods.sort(key=lambda p: p.metadata.name)
            for p in pods:
                if not p.spec.node_name:
                    continue  # unscheduled pods have no endpoint yet
                want.append(Endpoint(
                    addresses=[pod_ip(p)],
                    ready=p.status.phase == "Running",
                    node_name=p.spec.node_name,
                    target_ref=p.key,
                ))
        existing, _ = self.store.list(
            "endpointslices",
            lambda s: s.metadata.namespace == ns
            and s.metadata.labels.get(EndpointSlice.LABEL_SERVICE_NAME)
            == svc.metadata.name)
        by_name = {s.metadata.name: s for s in existing}
        chunks = [want[i:i + self.max_endpoints]
                  for i in range(0, len(want), self.max_endpoints)] or [[]]
        ports = list(svc.spec.ports)
        wanted_names = set()
        for i, chunk in enumerate(chunks):
            slice_name = f"{svc.metadata.name}-{i}"
            wanted_names.add(slice_name)
            if slice_name in by_name:
                def mutate(obj: EndpointSlice, chunk=chunk) -> EndpointSlice:
                    obj.endpoints = chunk
                    obj.ports = ports
                    return obj

                self.store.guaranteed_update(
                    "endpointslices", f"{ns}/{slice_name}", mutate)
            else:
                es = EndpointSlice(
                    metadata=ObjectMeta(
                        name=slice_name, namespace=ns, uid=new_uid(),
                        labels={EndpointSlice.LABEL_SERVICE_NAME: svc.metadata.name},
                        owner_references=[svc_owner_ref(svc)]),
                    endpoints=chunk, ports=ports)
                try:
                    self.store.create("endpointslices", es)
                except AlreadyExistsError:
                    self.store.guaranteed_update(
                        "endpointslices", f"{ns}/{slice_name}",
                        lambda obj, chunk=chunk: (setattr(obj, "endpoints", chunk),
                                                  setattr(obj, "ports", ports), obj)[-1])
        for s in existing:
            if s.metadata.name not in wanted_names:
                try:
                    self.store.delete("endpointslices", s.key)
                except NotFoundError:
                    pass

    def _delete_slices(self, ns: str, svc_name: str) -> None:
        slices, _ = self.store.list(
            "endpointslices",
            lambda s: s.metadata.namespace == ns
            and s.metadata.labels.get(EndpointSlice.LABEL_SERVICE_NAME) == svc_name)
        for s in slices:
            try:
                self.store.delete("endpointslices", s.key)
            except NotFoundError:
                pass
